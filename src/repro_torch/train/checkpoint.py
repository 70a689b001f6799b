"""Checkpoint/restart: atomic and retention-managed, in the JAX package's
layout (``train/checkpoint.py``).

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf (the key
path joined by ``__``) and ``manifest.json`` (the trees' keys, shapes and
dtypes, the step, the data-pipeline state and any extra).  Writes go to
``step_<N>.tmp``, which is renamed only after the manifest is fsynced: a
crash mid-save never corrupts the latest checkpoint.  Trees are nested
dicts of tensors, or a module (its ``state_dict``); the leaf keys of a
model's parameters are its ``state_dict`` names.  A bfloat16 leaf is stored
as float32 (NumPy has no bfloat16; the round trip is exact) with its dtype
in the manifest.

Restore loads the leaves on the host and places them on the caller's
device, in the dtypes of the ``like_*`` trees.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _tree(tree):
    return tree.state_dict() if isinstance(tree, torch.nn.Module) else tree


def _flatten(tree, prefix: str = "") -> dict:
    """``{key path: tensor}``, the path's parts joined by ``/``."""
    tree = _tree(tree)
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _file(path: str, name: str, key: str) -> str:
    return os.path.join(path, f"{name}__{key.replace('/', '__')}.npy")


def save(directory: str, step: int, *, params, opt_state=None,
         data_state=None, extra=None, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    trees = {"params": params}
    if opt_state is not None:
        trees["opt_state"] = opt_state
    manifest = {"step": step, "data_state": data_state or {},
                "extra": extra or {}, "trees": {}}
    for name, tree in trees.items():
        flat = _flatten(tree)
        manifest["trees"][name] = {
            k: {"shape": list(v.shape),
                "dtype": str(torch.as_tensor(v).dtype).replace("torch.", "")}
            for k, v in flat.items()}
        for k, v in flat.items():
            np.save(_file(tmp, name, k), _to_numpy(v))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(directory, keep)
    return final


def _steps(directory: str) -> list:
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _apply_retention(directory: str, keep: int) -> None:
    for d in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return int(steps[-1].split("_")[1]) if steps else None


def restore(directory: str, *, like_params, like_opt=None,
            step: int | None = None, device=None):
    """Loads a checkpoint into the structure of the ``like_*`` trees (a
    module stands for its ``state_dict``), each leaf in its like's dtype
    on ``device`` (default: the like's device).  Returns ``{"step",
    "params", "opt_state", "data_state", "extra"}``; load the parameters
    with ``model.load_state_dict(restored["params"])``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load_tree(name, like, prefix=""):
        if isinstance(like, dict):
            return {k: load_tree(name, v, f"{prefix}/{k}" if prefix
                                 else str(k)) for k, v in like.items()}
        arr = np.load(_file(path, name, prefix))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}/{prefix}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(arr).to(
            device=device if device is not None else like.device,
            dtype=like.dtype)

    params = load_tree("params", _tree(like_params))
    opt_state = None
    if like_opt is not None and "opt_state" in manifest["trees"]:
        opt_state = load_tree("opt_state", like_opt)
    return {"step": manifest["step"], "params": params,
            "opt_state": opt_state,
            "data_state": manifest.get("data_state", {}),
            "extra": manifest.get("extra", {})}


class CheckpointManager:
    """Periodic save + best-effort restore, with retention."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, **kw) -> str | None:
        if step % self.every == 0 and step > 0:
            return save(self.directory, step, keep=self.keep, **kw)
        return None

    def restore_or_none(self, **kw):
        try:
            return restore(self.directory, **kw)
        except FileNotFoundError:
            return None
